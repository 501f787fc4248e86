"""Uniform quantization (QAT) learner."""
