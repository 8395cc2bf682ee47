"""OSD-side stripe math and the batched encode + crc flush."""
