"""Core octree data model, LOD selection, frustum math, caches and
configuration: numpy copies of ``libre_tpu.core``'s host modules, so the
port imports nothing of the JAX package."""
