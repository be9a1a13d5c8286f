"""Host-side helpers of the port (NumPy only)."""
