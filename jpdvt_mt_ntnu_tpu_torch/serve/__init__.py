"""The puzzle service: HTTP transports, request gate, micro-batcher, int8 gate."""
