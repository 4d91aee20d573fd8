"""User-facing applications (the descriptor server)."""
