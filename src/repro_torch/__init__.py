"""PyTorch/CUDA port of the JAX package ``repro``.

It imports torch and numpy only, never jax and nothing of ``repro``: the
pure-Python parts it needs (configs, ``TokenStream``) are its own copies.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
