"""Serving: the continuous-batching LM engine (`engine`) and the streaming
EMVS engine (`emvs_stream`: `EMVSStreamEngine`, `MultiStreamEngine`,
built on `stream_session` and `sweep_dispatcher`)."""
