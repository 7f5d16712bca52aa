"""The plain fp32 reference the served tokens are held against."""
