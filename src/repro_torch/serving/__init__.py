"""Serving: the continuous-batching LM engine (`engine`). The streaming
EMVS engine waits for its slice (ROADMAP A5)."""
