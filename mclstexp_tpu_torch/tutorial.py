"""Worked end-to-end example (the reference's ``tutorial.ipynb`` as a script).

Port of ``examples/tutorial.py``, on synthetic data, in five steps:
  1. train the flagship contrastive model on two synthetic sections
     (``train_fold``; the rotation's shears run in the row_shift kernel on
     a card),
  2. embed every section with both towers,
  3. predict the held-out section's expression by top-K retrieval and write
     the prediction file,
  4. rank genes by prediction quality and plot the best gene's predicted
     and measured spatial maps (a PNG; without matplotlib the step says so
     and the run goes on),
  5. cluster the predicted expression into domains.

Swap ``synthetic.make_dataset`` for ``load_her2st(...)`` (with a 785-gene
panel) to run the HER2ST protocol.

Run:  python -m mclstexp_tpu_torch.tutorial [out_dir]   (on the card; the
CPU with ``main(out_dir, device="cpu")``)
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(out_dir: str = "tutorial_out", max_epochs: int = 20, device="cuda") -> dict:
    """Run the five steps on ``device``; returns the fold's metrics, the
    prediction (N, G), the gene ranking, the PNG's path (None where it was
    not written) and the clustering scores."""
    from mclstexp_tpu_torch.config import (
        Config, DataConfig, EvalConfig, ModelConfig, TrainConfig,
    )
    from mclstexp_tpu_torch.data import synthetic
    from mclstexp_tpu_torch.infer import analysis, embed, evaluate
    from mclstexp_tpu_torch.train.loop import train_fold
    from mclstexp_tpu_torch.utils.logging import MetricLogger

    os.makedirs(out_dir, exist_ok=True)
    fold = 0

    cfg = Config(
        model=ModelConfig(
            encoder_name="tiny_cnn", image_dim=128, spot_dim=32,
            projection_dim=32, heads_num=4, heads_dim=8, head_layers=2,
        ),
        train=TrainConfig(
            batch_size=32, max_epochs=max_epochs, lr=3e-3, weight_decay=1e-3,
            checkpoint_dir=os.path.join(out_dir, "model_result"), log_every=0,
        ),
        eval=EvalConfig(batch_size=16, top_k=16, weight_ord=1),
        data=DataConfig(dataset="synthetic", num_folds=3),
    )
    sections = synthetic.make_dataset(
        num_sections=3, num_spots=64, num_genes=32, patch_size=24, seed=11
    )
    gene_names = [f"GENE{i}" for i in range(32)]

    print("== 1. training fold 0 ==")
    state = train_fold(cfg, sections, fold, logger=MetricLogger(), device=device)

    print("== 2. embedding dump ==")
    img, spot = embed.compute_embeddings(state.model, sections, cfg.eval.batch_size,
                                         device=device)
    sizes = [s.num_spots for s in sections]
    img_secs = embed.split_by_section(img, sizes)
    spot_secs = embed.split_by_section(spot, sizes)

    print("== 3. retrieval prediction for the held-out section ==")
    pred_path = os.path.join(out_dir, "pred.npy")
    metrics = evaluate.evaluate_fold(
        fold, img_secs[fold], spot_secs,
        [s.expression for s in sections],
        top_k=cfg.eval.top_k, weight_ord=cfg.eval.weight_ord,
        prediction_path=pred_path, device=device,
    )
    print("fold metrics:", {k: round(v, 4) for k, v in metrics.items()})
    pred = np.load(pred_path).T  # stored genes x spots

    print("== 4. gene ranking + spatial plot ==")
    ranking = analysis.gene_ranking(
        [pred], [sections[fold].expression], gene_names, [sections[fold].name]
    )
    print(analysis.format_ranking(ranking, 5))
    best_gene = ranking["gene"][0]
    png = os.path.join(out_dir, f"{best_gene}.png")
    try:
        analysis.compare_gene_plot(
            sections[fold].centers, pred, sections[fold].expression, gene_names,
            best_gene, png,
        )
        print(f"wrote {png}")
    except ImportError as e:  # the plot alone needs matplotlib
        png = None
        print(f"{best_gene}.png not written: matplotlib is not importable ({e})")

    print("== 5. domain clustering ==")
    # synthetic sections carry no pathologist labels; cluster against a
    # 2-way split of the latent structure as a stand-in demonstration
    fake_labels = np.where(
        sections[fold].expression[:, 0] > np.median(sections[fold].expression[:, 0]),
        "high", "low",
    )
    clustering = analysis.domain_clustering(pred, fake_labels, device=device)
    print(clustering)
    return {"metrics": metrics, "pred": pred, "ranking": ranking, "png": png,
            "labels": fake_labels, "clustering": clustering}


if __name__ == "__main__":
    main(*sys.argv[1:2])
