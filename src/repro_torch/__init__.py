"""PyTorch/CUDA port of the OneRec-V2 FP8 serving stack (``repro``), for
NVIDIA Hopper.  Imports torch and numpy only, never the JAX package."""
