"""The plain reference: Mamba2 (SSD by its chunked definition), the Zamba2
shared attention block, the loss and AdamW, in float32 PyTorch with TF32
off.  It imports nothing of the program, of JAX or of the JAX package, and
takes only the weights and inputs the benchmark made."""
