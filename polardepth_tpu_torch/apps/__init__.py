"""Applications built on predicted depth."""
