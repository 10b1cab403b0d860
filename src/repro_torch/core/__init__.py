"""EMVS core in PyTorch: camera, geometry, DSI, voting, detection, pipeline."""
