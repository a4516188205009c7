"""CPU tests of the benchmark (and one marked for the card)."""
