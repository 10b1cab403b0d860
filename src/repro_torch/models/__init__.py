"""LM substrate of the port: layers, attention, KV cache, MoE, Mamba-2 and
the composed models of every LM family."""
