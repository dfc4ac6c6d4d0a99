"""LM serving: step functions (``steps``), the batched prefill + decode
loop (``serve``) and continuous batching (``scheduler``).

Training (``train``), the mesh and the dry-run tooling come with later slices
of the port.
"""
