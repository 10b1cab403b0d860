"""The paper's accuracy and runtime sections on the port:
`python -m repro_torch.benchmarks.<name> [--device cpu]`."""
