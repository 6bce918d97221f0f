"""Feature extraction from decoded clips."""
