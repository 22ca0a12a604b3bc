"""The model stack of the port: dense decoder LMs (attention + gated MLP)."""
