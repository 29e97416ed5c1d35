"""Animated-shot batching (port of facedeform_tpu/parallel, single-device
parts: batched.py).  The sharded modules wait for the multi-GPU slice."""
