"""The plain references, one module per metric class of the port (the file's
name is the class's). Plain PyTorch: nothing of torcheval_tpu_torch, of JAX
or of the JAX package."""
