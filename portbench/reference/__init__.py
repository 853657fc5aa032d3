"""Plain NumPy reference of the benchmark's deployments.

Imports nothing of the port (``saugns_tpu_torch``), of the JAX package
or of JAX: it renders the voice banks from the parameters that the
benchmark's script writer drew, with its own wave table.
"""
