"""Distribution layer: logical-axis sharding rules on a ``DeviceMesh``."""
