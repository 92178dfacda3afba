# Hand-written Hopper kernels of the port, one package each: kernel.py
# (the CUDA wrapper), ref.py (the plain PyTorch version), ops.py (the
# device dispatch) and any pipeline around them.  Sources under csrc/.
