"""Scene generators: each module's `generate(params, seed)` returns a
scenes.common.SceneData made from the seed on the host."""
