"""What every cell shares: the harness, the test audio, trace reduction and
the card's peaks."""
