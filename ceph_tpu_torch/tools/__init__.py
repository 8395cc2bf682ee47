"""Command-line tools: the EC non-regression corpus."""
