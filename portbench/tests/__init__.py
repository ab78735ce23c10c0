"""The CPU tests and the card's control test of the benchmark."""
