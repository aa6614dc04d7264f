"""Models of the port (YOLO)."""
