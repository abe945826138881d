"""Release tooling of the port (host only)."""
