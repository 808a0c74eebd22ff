"""Urban Greening Planner — interactive Streamlit app.

Capability parity with reference app/Home.py:50-416: GEE credential entry
with a cache-only fallback pinned to bundled demo tiles, sidebar
location/date inputs, checkpoint picker, four-layer display, a drawable
land-cover canvas **painted over the colorized DW map**, and predict →
NDVI / LST / ΔLST maps with the mean-cooling metric.

The port of ``maunet_tpu/apps/planner.py`` onto the port's
``PlannerEngine``, on the card unless ``--device`` says otherwise.  It
lists only ``.pth``/``.pt`` checkpoints (the port reads no orbax
directory).  All UI decisions are pure functions in apps/planner_core.py
(tested without streamlit); this module is the thin streamlit wiring.

Run:  streamlit run maunet_tpu_torch/apps/planner.py -- --models-dir models
Requires streamlit (+ streamlit_drawable_canvas for painting; degrades to
no-edit prediction without it); ``apps/headless.py`` runs it without.
"""

from __future__ import annotations

import argparse
import glob
import os

from maunet_tpu_torch.apps.engine import CANVAS_PALETTE, PlannerEngine
from maunet_tpu_torch.apps.planner_core import (
    canvas_background,
    layer_views,
    load_demo_layers,
    prediction_views,
    resolve_data_mode,
)


def _args():
    p = argparse.ArgumentParser()
    p.add_argument("--models-dir", default="models")
    p.add_argument("--cache-dir", default="app_cache")
    p.add_argument("--data-dir", default=None,
                   help="processed dataset dir (for normalization stats)")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--temporal-length", type=int, default=828,
                   help="CRU series length the model was trained with")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda unless asked for cpu)")
    known, _ = p.parse_known_args()
    return known


def main() -> None:
    import streamlit as st

    args = _args()
    st.set_page_config(page_title="Urban Greening Planner", layout="wide")
    st.title("🌳 Urban Greening Planner (H100)")
    st.markdown("Predict the microclimatic impact (LST & NDVI) of your "
                "urban scenarios.")

    # --- GEE credentials / cache-only flow (reference Home.py:50-126) ---
    default_project = os.getenv("GEE_PROJECT_ID", "")
    default_sa = os.getenv("GEE_SERVICE_ACCOUNT", "")
    with st.expander("Google Earth Engine Credentials",
                     expanded=not (default_project and default_sa)):
        project_id = st.text_input("GEE Project ID", value=default_project)
        service_account = st.text_input("GEE Service Account", value=default_sa)
        os.environ["GEE_PROJECT_ID"] = project_id
        os.environ["GEE_SERVICE_ACCOUNT"] = service_account
    data_mode = resolve_data_mode(project_id, service_account,
                                  os.path.exists(".private-key.json"))
    if data_mode.mode == "cache":
        st.warning(f"⚠️ {data_mode.reason}")
    d = data_mode.defaults

    # --- Sidebar: location/date/model (reference Home.py:128-172) ---
    with st.sidebar:
        st.header("Location & Time")
        lat = st.number_input("Latitude", -60.0, 70.0, d["lat"], step=0.01)
        lon = st.number_input("Longitude", -180.0, 180.0, d["lon"], step=0.01)
        population = st.number_input("Population", 0, 50_000_000,
                                     int(d["population"]))
        year_t1 = st.number_input("Observation year (t1)", 2017, 2025, d["year"])
        month_t1 = st.number_input("Observation month (t1)", 1, 12, d["month"])
        year_t2 = st.number_input("Target year (t2)", 2017, 2035, 2025)
        month_t2 = st.number_input("Target month (t2)", 1, 12, d["month"])

        ckpts = sorted(glob.glob(os.path.join(args.models_dir, "*.pth"))
                       + glob.glob(os.path.join(args.models_dir, "*.pt")))
        if not ckpts:
            st.error(f"No checkpoints found in {args.models_dir}")
            st.stop()
        ckpt = st.selectbox("Model checkpoint", ckpts)

    @st.cache_resource
    def get_engine(path: str) -> PlannerEngine:
        stats = None
        if args.data_dir:
            from maunet_tpu_torch.data.schema import NormalizationStats

            stats_path = os.path.join(args.data_dir, "normalization_metrics.json")
            if os.path.exists(stats_path):
                stats = NormalizationStats.from_json(stats_path)
        return PlannerEngine(path, device=args.device, stats=stats,
                             img_size=args.img_size,
                             temporal_length=args.temporal_length)

    engine = get_engine(ckpt)

    # --- Fetch layers (reference Home.py:182-278) ---
    if st.button("Fetch Satellite Data") or "layers" not in st.session_state:
        try:
            if data_mode.mode == "live":
                from maunet_tpu_torch.apps.gee_fetch import get_satellite_data

                st.session_state.layers = get_satellite_data(
                    lat, lon, int(year_t1), int(month_t1), args.cache_dir,
                    args.img_size)
            else:
                from maunet_tpu_torch.apps.gee_fetch import load_cached_layers

                st.session_state.layers = load_cached_layers(
                    args.cache_dir, args.img_size)
        except Exception as e:
            st.warning(f"Could not load satellite layers ({e}); using the "
                       "bundled demo tiles.")
            st.session_state.layers = load_demo_layers(args.img_size)

    layers = st.session_state.layers
    for col, (img, caption) in zip(st.columns(4), layer_views(layers)):
        col.image(img, caption=caption)

    # --- Drawable canvas over the DW map (reference Home.py:280-328) ---
    st.header("Design Future Scenario")
    st.markdown("Paint your land-cover change directly on the map.")
    canvas_rgba = None
    try:
        from streamlit_drawable_canvas import st_canvas

        brush_names = ["water", "trees", "grass", "flooded veg", "crops",
                       "shrub", "built", "bare", "snow"]
        brush = st.radio("Brush class", list(range(9)), horizontal=True,
                         format_func=lambda i: f"{brush_names[i]}")
        canvas = st_canvas(
            fill_color=CANVAS_PALETTE[brush] + "AA",
            stroke_color=CANVAS_PALETTE[brush],
            stroke_width=st.slider("Brush size", 2, 60, 20),
            background_image=canvas_background(layers["dw"]),
            update_streamlit=True,
            height=args.img_size, width=args.img_size,
            drawing_mode="freedraw", key="canvas")
        if canvas is not None and canvas.image_data is not None:
            canvas_rgba = canvas.image_data
    except ImportError:
        st.info("streamlit_drawable_canvas not installed — predicting "
                "without land-cover edits.")

    # --- Predict (reference Home.py:330-416) ---
    if st.button("Run Prediction", type="primary"):
        with st.spinner("Running inference..."):
            inp_base = engine.prepare_input(layers, None, lat, lon, population,
                                            year_t1, month_t1, year_t2, month_t2)
            _, lst_base = engine.predict(inp_base)
            inp_mod = engine.prepare_input(layers, canvas_rgba, lat, lon,
                                           population, year_t1, month_t1,
                                           year_t2, month_t2)
            ndvi_mod, lst_mod = engine.predict(inp_mod)

        views, delta_mean = prediction_views(ndvi_mod, lst_mod, lst_base)
        for col, (img, caption) in zip(st.columns(3), views):
            col.image(img, caption=caption)
        st.metric("Mean temperature change of your plan",
                  f"{delta_mean:+.2f} °C")


if __name__ == "__main__":
    main()
