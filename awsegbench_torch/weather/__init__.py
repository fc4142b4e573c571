"""Weather corruption and the heuristic depth estimator."""
