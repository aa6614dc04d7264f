"""Host-side helpers: numpy drawing for debug posts, tree utilities."""
