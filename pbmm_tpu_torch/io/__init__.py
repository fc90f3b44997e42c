"""Video I/O: y4m and array files, device-side decode, streaming."""
