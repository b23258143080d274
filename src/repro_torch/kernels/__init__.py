"""Hand-written CUDA kernels for Hopper and their wrappers.  Nothing here
imports a compiler or touches the card at import time."""
