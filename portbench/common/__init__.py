"""What every driver shares: the card and import guards, the weights and
inputs made from the seed, the trace reader and the result line."""
