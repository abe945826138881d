"""Human-in-the-loop counterfactual annotation (SURVEY L10).

A copy of ``creste_public_tpu/annotation``: candidate counterfactual
trajectories around the expert (``control``), ranked by a human in a
stdlib ``http.server`` app (``app``; reference scripts/traversability/rlhf,
Flask on :4242) and written as ``counterfactuals/{seq}/{frame}.pkl`` for
stage-3 counterfactual IRL. The app reads the port's ``CodaDataset``.

    python -m creste_public_tpu_torch.annotation.app --root D [--port 4242]
"""
