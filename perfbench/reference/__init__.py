"""The plain reference that decides ``correct``: EQUSS in plain PyTorch,
f32 with TF32 off, written from the published models (DINO's ViT, the
EQUSS head, product quantization, the probes, STEGO's loss) and the
configuration.  It imports nothing of the program, nor JAX.  Every part
takes a precision, so that the same code computed one step below the
configuration's stated precisions is the control (``precision.py``)."""
