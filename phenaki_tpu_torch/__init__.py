"""PyTorch + CUDA port of phenaki_tpu for NVIDIA Hopper (H100).

The JAX package `phenaki_tpu` is the reference; this package keeps its
module layout (ops/, models/, text/, data/, utils/, parallel/, training/,
presets.py) and imports no JAX.
Its hand-written CUDA kernels (csrc/) replace the TPU package's Pallas
kernels on the flagship text-to-video sampling path (plain, critic-guided
and the logits path) and the MaskGit and critic training path:

* ops/flash_attention.py  <-> phenaki_tpu/ops/pallas_attention.py
  (the forward and its dQ, dK/dV and dBias backward kernels)
* ops/fused_sampling.py   <-> phenaki_tpu/ops/pallas_sampling.py
  (the fused projection sampler and the logits-path sampler)
* ops/fused_ce.py         <-> phenaki_tpu/ops/pallas_ce.py
  (the fused vocab cross-entropy and its dh and dW backward kernels)

The kernels are built with nvcc at first CUDA use (_build.py). Each wrapper
takes its plain PyTorch version only for a CPU tensor.
"""
