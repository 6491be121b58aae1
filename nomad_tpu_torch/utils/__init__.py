"""Small self-contained libraries (own copies): the lock witness."""
