"""Core octree data model, LOD selection, frustum math, caches,
configuration, settings and events: numpy copies of ``libre_tpu.core``'s
host modules, so the port imports nothing of the JAX package."""
