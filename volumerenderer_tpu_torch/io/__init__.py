"""Host-side volume sources for the PyTorch port: synthetic volumes
(``synthetic``) and bricked loads (``bricks``)."""
