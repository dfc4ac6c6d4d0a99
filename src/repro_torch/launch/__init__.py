"""LM serving and training, and the mesh tooling: step functions and shape
stand-ins (``steps``), the batched prefill + decode loop (``serve``),
continuous batching (``scheduler``), the training driver (``train``), the
meshes (``mesh``) and layouts (``sharding``), and the dry-run (``dryrun``)
with its per-device cost counter (``hlo_cost``) and H100 roofline
(``roofline``).
"""
