"""The benchmark's plain reference: the models of each configuration in
plain PyTorch, float32 with TF32 off, no kernels, no cache, no batching
tricks. A frozen copy of the codecs' mathematics, kept here so that a change
to the program cannot change its yardstick. It imports nothing of the
program: a test checks that.

``numerics`` holds the one switch the reference has: the lower-precision
control (:func:`numerics.control`), which rounds the operands of the layers
the configurations run in bfloat16 to fp8 and lets the float32 ones use
TF32.
"""
