"""Mesh construction and the collective layer of the relational engine on
several ranks (``launch/mesh.py``, ``launch/collectives.py``)."""
