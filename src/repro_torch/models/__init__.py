"""The model-serving path (port of ``repro.models``): layers, MoE, the
Griffin and RWKV blocks, the ``Transformer`` module and serving."""
