"""The non-uniform (learned codebook) quantization learner ('non-uniform')."""
