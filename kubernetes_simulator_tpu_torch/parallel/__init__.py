"""Node-plane sharding of one scenario (:mod:`.shards`)."""
