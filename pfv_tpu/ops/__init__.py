"""Batched device ops: DCT, quantization, blocks, motion, residuals, color."""
