"""The deployment-grade QAT learner ('uniform-tf')."""
