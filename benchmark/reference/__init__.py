"""The plain fp32 reference of the benchmark's models (imports nothing
of the port)."""
