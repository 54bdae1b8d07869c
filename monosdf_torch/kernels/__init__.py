"""Hand-written Hopper kernels of the render and training paths and their
plain versions.

K1 ``sdf_mlp``, K4 ``sampler_machinery``, K2 ``sdf_grad`` (forward K2f and
backward K2b, ``sdf_grad_bwd``) and K3 ``radiance_norm`` (forward K3f and
backward K3b, ``radiance_norm_bwd``). Each wrapper runs its plain PyTorch
version on a CPU tensor and launches its CUDA kernel on a CUDA tensor; see
``build``.
"""
