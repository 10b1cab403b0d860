"""LM substrate of the port: layers, attention, KV cache, composed models
(attention-only families; MoE and Mamba-2 wait for their slices)."""
