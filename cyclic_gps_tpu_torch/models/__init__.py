"""LEG model family."""
