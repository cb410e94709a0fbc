"""Launch layer (port of ``repro.launch``): meshes, placement specs, the
train and serving step factories, the batch server and the train and serve
CLIs."""
