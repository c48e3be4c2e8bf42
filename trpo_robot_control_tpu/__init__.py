"""TRPO trajectory-optimization engine for robot-arm control on the GPU.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference FPGA-accelerated TRPO robot-control stack (see SURVEY.md):
batched arm rollouts (a fused Pallas-Triton kernel on the GPU),
Fisher-vector-product / conjugate-gradient natural-gradient updates, GAE + KL line search fully on-device,
and data-parallel scaling over a `jax.sharding.Mesh`.
"""
__version__ = "0.1.0"
