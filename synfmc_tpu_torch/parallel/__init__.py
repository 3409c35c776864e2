"""The multi-GPU mesh (``mesh.py``) and its explicit collectives (``collectives.py``)."""
