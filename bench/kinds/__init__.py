"""One module per traffic kind, found by the mix's ``kind``."""
