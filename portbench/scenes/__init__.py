"""Scene generators, one module a scene kind, named by a configuration's
`scene` key.  Each has describe(config, seed) -> a scene description: plain
data that both the program's adapter (portbench/port.py) and the reference
(portbench/reference/) build from."""
