"""Distribution of the port: logical-axis sharding rules over a torch
``DeviceMesh`` and the int8 gradient collectives."""
