"""HTTP /edit and websocket /stream serving of the port."""
