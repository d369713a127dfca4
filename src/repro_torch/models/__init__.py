"""The model zoo of the port (the serving path of gemma3-1b first)."""
