"""Research and figures app (Streamlit).

The port's copy of ``maunet_tpu/apps/research.py``, the reference's six-page
research app (app_dev/Home.py and pages/*): a single-model browser with the
architecture diagram and a prediction on a test sample, a side-by-side
comparison of evaluation runs, evaluation-CSV dashboards, statistical
comparison (paired t-tests, Wilcoxon, Mann-Whitney and Pearson, with the
significance matrices), the dataset's geo-distribution and a metric
interpretation page.  Every widget label is the JAX app's.

The model browser loads a ``.pth``/``.pt`` checkpoint through the port's
``load_any_checkpoint`` on ``--device`` (the card unless asked otherwise)
and predicts the first test sample of ``--data-dir`` through
``make_batches`` and ``evaluator.predict_batch``.  Where matplotlib (or, for
the matrices, seaborn) is not installed, as on the GPU host, each figure a
page would draw is one ``st.info`` line and the page goes on.

Run:  streamlit run maunet_tpu_torch/apps/research.py -- --reports-dir reports/tests
      [--data-dir D] [--device cuda]
Without streamlit: ``python -m maunet_tpu_torch.apps.headless research ...``.
pandas is imported inside the pages that use it.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os


def _args():
    p = argparse.ArgumentParser()
    p.add_argument("--reports-dir", default="reports/tests")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked for cpu)")
    known, _ = p.parse_known_args()
    return known


def _find_eval_csvs(reports_dir: str) -> dict[str, str]:
    return {os.path.basename(f).replace("_evaluation.csv", ""): f
            for f in sorted(glob.glob(os.path.join(reports_dir, "*_evaluation.csv")))}


def _can_draw(st, what: str, needs: tuple[str, ...] = ("matplotlib",)) -> bool:
    """Whether the figure ``what`` can be drawn here; if not, one line says so."""
    missing = [m for m in needs if importlib.util.find_spec(m) is None]
    if missing:
        st.info(f"{what}: not drawn, {' and '.join(missing)} not installed")
    return not missing


def page_model_browser(st, args):
    st.header("Model browser")
    from maunet_tpu_torch.evaluate.checkpoint import load_any_checkpoint

    path = st.text_input("Checkpoint path (.pth or orbax dir)")
    if not path:
        return
    try:
        loaded = load_any_checkpoint(path, device=args.device)
    except ValueError as e:   # not a .pth/.pt file
        st.error(str(e))
        return
    hp = loaded.hyperparams
    st.json(hp)
    n = sum(p.numel() for p in loaded.model.parameters())
    st.metric("Parameters", f"{n:,}")
    # The interactive node graph (the reference's streamlit-flow diagram,
    # app_dev/app_src/model_diagram.py:8-222) as self-contained HTML/SVG.
    from maunet_tpu_torch.analysis.diagram_html import model_diagram, render_html

    try:
        html_component = st.components.v1.html
    except AttributeError:  # real streamlit: the submodule needs its own import
        import streamlit.components.v1 as _components

        html_component = _components.html
    html_component(render_html(model_diagram(hp)), height=580)
    with st.expander("Static figure"):
        if _can_draw(st, "Static architecture figure"):
            from maunet_tpu_torch.analysis.figures import plot_architecture_diagram

            st.pyplot(plot_architecture_diagram(hp))
    with st.expander("Text diagram"):
        st.text(architecture_diagram(hp))

    if args.data_dir and st.button("Predict a test sample (zoomed quadrants)"):
        from maunet_tpu_torch.data.dataset import NpzDataset, make_batches
        from maunet_tpu_torch.evaluate.evaluator import predict_batch

        ds = NpzDataset(os.path.join(args.data_dir, "test"))
        batch = next(make_batches(ds, 1))
        preds = predict_batch(loaded, batch)
        for ch_idx, ch in enumerate(("NDVI", "LST")):
            if _can_draw(st, f"Zoomed {ch} quadrants"):
                from maunet_tpu_torch.analysis.figures import plot_zoomed_views

                st.pyplot(plot_zoomed_views(
                    batch.targets[0, :, :, ch_idx], preds[0, :, :, ch_idx], ch, error=True))


def architecture_diagram(hp: dict) -> str:
    """ASCII architecture diagram (the reference renders an interactive
    streamlit-flow diagram, app_dev/app_src/model_diagram.py:8-222)."""
    bf = int(hp.get("base_filters", 64))
    filters = [bf * 2 ** i for i in range(5)]
    lines = ["Input (H, W, 23)"]
    for i, f in enumerate(filters[:-1]):
        lines.append(f"{'  ' * i}└─ VGGBlock conv{i}_0 → {f}ch → maxpool 2×2")
    embed = []
    if hp.get("temporal_embeddings", True):
        embed.append(f"LSTM({hp.get('lstm_hidden', 96)}) → {hp.get('temporal_dim', 64)}d")
    if hp.get("metadata_embeddings", True):
        embed.append(f"MLP → {hp.get('meta_dim', 64)}d")
    fuse = " + ".join(embed) if embed else "no embeddings"
    lines.append(f"{'  ' * 4}└─ bottleneck conv4_0 → {filters[-1]}ch  [fused: {fuse}]")
    for i in reversed(range(4)):
        lines.append(f"{'  ' * i}┌─ up ×2 (align-corners) + skip → conv{i}_1 → {filters[i]}ch")
    lines.append("Output 1×1 conv → (NDVI: tanh, LST: identity)")
    return "\n".join(lines)


def page_comparison(st, args):
    import pandas as pd

    st.header("Model comparison")
    csvs = _find_eval_csvs(args.reports_dir)
    chosen = st.multiselect("Evaluation runs", list(csvs), default=list(csvs)[:2])
    if len(chosen) < 1:
        return
    rows = []
    for name in chosen:
        df = pd.read_csv(csvs[name])
        overall = df[df["dw_class"] == "overall"]
        for ch, g in overall.groupby("channel"):
            rows.append({"model": name, "channel": ch,
                         "mae": g["mae"].mean(), "rmse": g["rmse"].mean(),
                         "lap_var_pred": g["laplacian_var_pred"].mean()})
    st.dataframe(pd.DataFrame(rows).pivot(index="model", columns="channel"))


def page_analysis(st, args):
    import pandas as pd

    st.header("Evaluation analysis")
    csvs = _find_eval_csvs(args.reports_dir)
    if not csvs:
        st.info("No evaluation CSVs found.")
        return
    name = st.selectbox("Run", list(csvs))
    df = pd.read_csv(csvs[name])
    channel = st.selectbox("Channel", sorted(df["channel"].unique()))
    sub = df[(df["channel"] == channel) & (df["dw_class"] == "overall")]
    c1, c2, c3 = st.columns(3)
    c1.metric("MAE", f"{sub['mae'].mean():.4f}")
    c2.metric("RMSE", f"{sub['rmse'].mean():.4f}")
    c3.metric("Samples", len(sub))
    st.subheader("Per-class MAE")
    per_class = (df[(df["channel"] == channel) & (df["dw_class"] != "overall")]
                 .groupby("dw_class")["mae"].mean().sort_values())
    st.bar_chart(per_class)
    st.subheader("Known vs unknown cities")
    st.dataframe(sub.groupby("is_known_city")[["mae", "rmse"]].mean())
    st.subheader("Error vs temporal distance")
    st.line_chart(sub.groupby("t1_year")["mae"].mean())


def page_statistics(st, args):
    import pandas as pd

    st.header("Statistical comparison")
    from maunet_tpu_torch.analysis.stats import comparative_analysis, nonparametric_tests

    csvs = _find_eval_csvs(args.reports_dir)
    chosen = st.multiselect("Runs to compare", list(csvs), default=list(csvs)[:2])
    if len(chosen) < 2:
        st.info("Pick at least two runs.")
        return
    paths = [csvs[c] for c in chosen]
    st.subheader("Paired t-tests")
    tt = comparative_analysis(paths, chosen)
    st.dataframe(tt[tt["winner"] != "insignificant"] if not tt.empty else tt)
    st.subheader("Wilcoxon / Mann-Whitney / Pearson")
    st.dataframe(nonparametric_tests(paths, chosen))

    channel = st.selectbox(
        "Channel", sorted(pd.read_csv(paths[0])["channel"].unique()))
    metric = st.radio("Metric", ["mae", "rmse"], horizontal=True)
    from maunet_tpu_torch.analysis import figures

    st.subheader("Pairwise significance matrix (Wilcoxon)")
    if _can_draw(st, "Pairwise significance matrix", ("matplotlib", "seaborn")):
        _, fig = figures.significance_matrix(paths, chosen, channel, metric)
        st.pyplot(fig)
    st.subheader("Sample-wise error correlation")
    if _can_draw(st, "Sample-wise error correlation", ("matplotlib", "seaborn")):
        _, fig = figures.error_correlation_matrix(paths, chosen, channel, metric)
        st.pyplot(fig)


def page_dataset(st, args):
    import pandas as pd

    st.header("Dataset geo-distribution")
    if not args.data_dir:
        st.info("Pass --data-dir to inspect a processed dataset.")
        return
    from maunet_tpu_torch.data.dataset import NpzDataset

    rows = []
    for split in ("train", "val", "test"):
        split_dir = os.path.join(args.data_dir, split)
        if not os.path.isdir(split_dir):
            continue
        ds = NpzDataset(split_dir)
        for i in range(len(ds)):
            info = ds.get_metadata_from_idx(i)
            rows.append({**info, "split": split})
    df = pd.DataFrame(rows)
    if _can_draw(st, "Dataset geo-distribution figure"):
        from maunet_tpu_torch.analysis.figures import plot_dataset_geomap

        st.pyplot(plot_dataset_geomap(df))
    st.map(df.rename(columns={"lat": "latitude", "lon": "longitude"}))
    st.dataframe(df.groupby(["split", "city"]).size().rename("samples"))


def page_interpretation(st, args):
    import pandas as pd

    st.header("Metric interpretation")
    from maunet_tpu_torch.analysis.stats import interpret_metrics

    csvs = _find_eval_csvs(args.reports_dir)
    if not csvs:
        st.info("No evaluation CSVs found.")
        return
    name = st.selectbox("Run", list(csvs))
    rows = interpret_metrics(csvs[name], name)
    st.dataframe(pd.DataFrame(rows))


PAGES = {
    "Model browser": page_model_browser,
    "Model comparison": page_comparison,
    "Evaluation analysis": page_analysis,
    "Statistical comparison": page_statistics,
    "Dataset map": page_dataset,
    "Metric interpretation": page_interpretation,
}


def main() -> None:
    import streamlit as st

    args = _args()
    st.set_page_config(page_title="MAUNet Research", layout="wide")
    page = st.sidebar.radio("Page", list(PAGES))
    PAGES[page](st, args)


if __name__ == "__main__":
    main()
