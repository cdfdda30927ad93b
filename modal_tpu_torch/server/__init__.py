"""Server-side pieces of the port that need neither gRPC nor protobuf:
the fleet compile-cache store (`compile_cache.py`)."""
