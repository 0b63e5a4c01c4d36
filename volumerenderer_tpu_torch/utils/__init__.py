"""Small helpers of the PyTorch port (packed code arrays)."""
