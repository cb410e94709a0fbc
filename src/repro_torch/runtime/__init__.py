"""The serving front: the batched query engine."""
