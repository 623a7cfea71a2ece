"""Meshes, MANO, projection, the surface renderer and the conditioning front end."""
