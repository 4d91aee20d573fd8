"""Host-side helpers (constants, YAML IO, device selection)."""
