"""Hand-written CUDA kernels (sm_90a): the EMVS hot spots and LM attention.

Each kernel package ships three files, as the reference's do:
  kernel.py — the ctypes launcher of the CUDA source in `csrc/`
  ops.py    — the public wrapper; the tensor's device picks the path
  ref.py    — the plain PyTorch version (the CPU path, and the yardstick
              the kernel is held to on the card)

Kernels:
  backproject_vote — P(Z0 -> Zi) + vote + int16 store, one CTA per
                     (plane, segment) with a shared-memory accumulator.
  local_max        — depth max/argmax + parabola refinement, one thread
                     per pixel.
  flash_attention  — causal/GQA softmax attention with an online softmax,
                     one CTA per (query tile, batch*head) looping over
                     KV tiles: wgmma on bf16 operands fed by a TMA ring
                     (bf16, D % 16 == 0), float32 FMAs otherwise.
"""
