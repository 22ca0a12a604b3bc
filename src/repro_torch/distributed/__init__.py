"""Key-range sharding of the VCS pipeline."""
