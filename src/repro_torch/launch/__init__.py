"""Launch layer (port of ``repro.launch``): meshes, placement specs, the
serving step factories and the batch server."""
