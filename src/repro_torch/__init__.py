"""PyTorch/CUDA port of the SAFL system in ``repro`` (the JAX reference).

Module for module it mirrors ``repro``: ``prng`` reproduces the
reference's ``jax.random`` streams, ``core`` the sketches, the packed
engine, the adaptive server and the SAFL round, ``kernels`` the Hopper
kernels that replace the Pallas ones, ``models``/``data``/``launch`` the
dense LM, the federated sampler and the round driver.  Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
