"""The multi-part tier on stacked parts: halo plans and transports
(:mod:`.halo`, :mod:`.halo_dma`), mesh reductions (:mod:`.reductions`)
and the distributed CG solver (:mod:`.dist`)."""
