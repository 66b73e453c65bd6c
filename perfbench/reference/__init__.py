"""Plain PyTorch reference of the served models, in fp32 with TF32 off.

It imports nothing of the program under test and takes nothing it made."""
