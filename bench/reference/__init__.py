"""Plain reference of the EMVS semantics the benchmark holds the port to."""
