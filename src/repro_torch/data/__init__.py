"""Data substrate: seeded synthetic datasets and the dataset registry."""
