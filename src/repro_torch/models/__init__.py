"""The paged text-model slice: layers, the transformer's serving step, and
the converter from the JAX package's parameters."""
