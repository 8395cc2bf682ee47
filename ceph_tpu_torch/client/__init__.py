"""Client I/O engine + librados-style API (src/osdc/ + src/librados/)."""
