"""The plain reference of the planar model: float32 PyTorch with TF32 off,
no kernels, written from the published description (BARF's planar
alignment, MARF's masks and edge loss, Ha-NeRF's mask heads). It imports
nothing of the port and nothing of the JAX package."""
