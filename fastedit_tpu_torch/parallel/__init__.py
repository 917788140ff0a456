"""Data parallelism: one editor replica per device (``replicas.py``, the
counterpart of the JAX package's ``parallel/mesh.py``), processes joined by
``torch.distributed`` over gloo (``multihost.py``), and the PIE-Bench sweep
over them (``batch.py``); tensor parallelism within a replica's group of
devices (``tp.py``, the JAX package's ``parallel/tp.py`` rules), in one
process or across several (``multihost.members``)."""
