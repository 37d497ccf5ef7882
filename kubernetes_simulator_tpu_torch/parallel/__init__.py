"""Node-plane sharding of one scenario (:mod:`.shards`) and the what-if
batch's scenario axis over local devices (:mod:`.mesh`)."""
