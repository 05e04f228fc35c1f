"""Step builders of the port (one device; sharding is not ported yet)."""
