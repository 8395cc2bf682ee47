"""OSD: the daemon, its PG layer and EC backend, the stripe math, the
batched encode + crc flush and the device engine."""
