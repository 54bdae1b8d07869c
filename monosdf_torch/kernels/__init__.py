"""Hand-written Hopper kernels of the render and training paths and their
plain versions.

K1 ``sdf_mlp`` (and K1-PE, ``sdf_mlp_pe``, on raw points), K4
``sampler_machinery``, K2 ``sdf_grad`` (forward K2f and
backward K2b, ``sdf_grad_bwd``) and K3 ``radiance_norm`` (forward K3f and
backward K3b, ``radiance_norm_bwd``, with the per-image code operand); the
radiance kernels K8a ``radiance_split`` (``rgb_backend='pallas'``, and its
backward ``radiance_split_bwd``) and K8b ``radiance_mlp`` (nerf mode, and
``radiance_mlp_bwd``); for the hash-grid model K6
``hash_encode`` (the encode), K5 ``hash_encode_bwd`` (its table gradient)
and K7 ``sdf_grad_grid`` (the grid trunk, K7f, and its backward K7b,
``sdf_grad_grid_bwd``); and the five probe kernels of
``scripts/probe_hash_primitives.py``'s port (``probes``: G, S, R, M, C).
K1's and K2b's bf16 paths run on the tensor cores (``csrc/wgmma.cuh``).
Each wrapper runs its plain PyTorch version on a CPU tensor and launches its
CUDA kernel on a CUDA tensor; see ``build``.
"""
