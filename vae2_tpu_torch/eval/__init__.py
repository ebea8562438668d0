"""Sample-quality evaluation: FID and the Inception Score."""
