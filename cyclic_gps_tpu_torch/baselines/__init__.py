"""Dense oracles."""
