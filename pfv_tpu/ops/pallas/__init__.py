"""Pallas kernels for the decode hot path (GPU, Triton route).

Each kernel has a jnp twin in pfv_tpu.ops.* / pfv_tpu.dataloader that
serves as the bit-exact oracle; tests assert kernel == oracle on every
element (the kernels run in the Pallas interpreter on the CPU).
"""
