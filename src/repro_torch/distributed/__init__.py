"""`torch.distributed` counterparts of `repro.distributed`: the EMVS
parallelism levels (`emvs.py`), the LM sharding rules (`sharding.py`),
expert parallelism (`expert_parallel.py`), flash-decode (`flash_decode.py`),
gradient compression (`compression.py`), the collectives their bodies use
(`collectives.py`) and fault tolerance (`fault_tolerance.py`)."""
