"""The plain reference: each architecture's model in float32 PyTorch with
TF32 off (``mamba2.py``: Mamba2, SSD by its chunked definition), the
precision of its products (``matmul.py``; ``lowp.py``, the float8 control),
and AdamW.  It imports nothing of the program, of JAX or of the JAX
package, and takes only the weights and inputs the benchmark made."""
