"""A test double of the ZED SDK's Python package (``pyzed``); see ``sl``."""
