"""Multi-device scaling: device meshes, sharded render steps, collectives."""
