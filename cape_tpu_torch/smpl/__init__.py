"""SMPL body model pieces of the port: joint metadata, Rodrigues maps
(numpy and torch) and linear blend skinning in torch."""
