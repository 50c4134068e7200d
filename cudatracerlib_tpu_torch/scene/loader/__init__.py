"""Mitsuba scene loading: the XML scene, OBJ, PLY and serialized meshes, images."""
