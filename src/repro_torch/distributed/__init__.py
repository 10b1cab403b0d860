"""Distributed EMVS over `torch.distributed` (counterpart of the EMVS part
of `repro.distributed`)."""
