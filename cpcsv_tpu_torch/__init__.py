"""cpcsv_tpu_torch: the PyTorch/CUDA port of cpcsv_tpu for NVIDIA Hopper.

It imports nothing of the JAX package. Entry points run on "cuda" and raise
without a card unless the caller asks for device="cpu".
"""
