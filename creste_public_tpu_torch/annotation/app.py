"""Counterfactual annotation web app (stdlib http.server).

A copy of ``creste_public_tpu/annotation/app.py`` over the port's
``CodaDataset`` (``data/coda_dataset.py``) and renders
(``utils/visualization.overlay_trajectory``, PIL PNG); ``_PAGE`` is the
JAX package's page, byte for byte. The app is host code: it reads the
tree and draws on the CPU, with no device.

    python -m creste_public_tpu_torch.annotation.app --root D \
        [--port 4242] [--host 0.0.0.0] [--sampler epsilon|unicycle] \
        [--num_candidates 5]

Parity target: scripts/traversability/rlhf/app.py — Flask on :4242 with
  * GET  /load?seq=..&frame=..  -> candidate trajectories around the expert
    (unicycle rollouts or epsilon-spline perturbations, Hausdorff-filtered)
    plus a base64 BEV render for the UI (:85-199),
  * POST /save -> {trajectories, rank, seq, frame} pickled to
    counterfactuals/{seq}/{frame}.pkl (:201-225),
  * an interactive built-in frontend at reference UX parity (static/js/
    plot_trajectories.js + templates/index.html): canvas trajectory
    plotting over the BEV image, color-synced hoverable ranking list,
    regenerate / next-sample / go-to-index navigation, front-view pane —
    dependency-free inline JS (the reference pulls Plotly from a CDN,
    impossible under zero egress).
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import pickle
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from creste_public_tpu_torch.annotation import control as ctl

# Interactive frontend at reference UX parity (plot_trajectories.js +
# templates/index.html behaviors: client-side trajectory plotting over the
# BEV image, color-synced ranking list with hover highlighting, candidate
# regeneration, next/go-to-index navigation, front-view image, save toast)
# — but dependency-free inline JS on a <canvas> instead of the Plotly CDN
# (zero-egress environments cannot load CDNs), and drag-RANKING instead of
# the reference's binary optimal/suboptimal toggle (our save contract is a
# full preference order, which the reference's ranked IRL losses consume).
_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>CREStE counterfactual ranking</title>
<style>
body{font-family:sans-serif;margin:1.5em;background:#1c1e22;color:#e8e8e8}
button,input{font:inherit;padding:4px 8px;margin:2px;background:#2c2f35;
 color:#e8e8e8;border:1px solid #555;border-radius:4px}
button{cursor:pointer}button:hover{background:#3a3e46}
#wrap{display:flex;gap:20px;align-items:flex-start;margin-top:10px}
#bev{border:1px solid #555;cursor:crosshair}
#front{max-width:512px;border:1px solid #555;display:block;margin-top:8px}
#ranks{list-style:none;padding:0;width:260px;margin:0}
#ranks li{margin:4px 0;padding:6px 8px;border:1px solid #444;cursor:grab;
 background:#2c2f35;border-left:14px solid #888;border-radius:4px;
 transition:background .1s}
#ranks li.hi{background:#454a54}
#toast{display:none;position:fixed;bottom:20px;right:20px;background:#2e7d32;
 color:#fff;padding:12px 16px;border-radius:6px}
</style></head><body>
<h3>Rank counterfactual trajectories (drag best to top)</h3>
<div>
 <label>seq <input id=seq value=0 size=4></label>
 <label>frame <input id=frame value=0 size=6></label>
 <button id=load-btn onclick=load()>Load</button>
 <button id=next-btn onclick=nextSample()>Next Sample</button>
 <label>index <input id=idx type=number size=5 style="width:70px"></label>
 <button id=goto-btn onclick=gotoIndex()>Go To Index</button>
 <button id=regen-btn onclick=regen()>Regenerate Trajectories</button>
 <button id=save-btn onclick=save()>Save Labels</button>
</div>
<p id=seq-frame-display>Sample: N/A</p>
<div id=wrap>
 <div>
  <h4>Ranking (best first)</h4><ol id=ranks></ol>
 </div>
 <div>
  <canvas id=bev width=512 height=512></canvas>
  <img id=front alt="front view" style="display:none">
 </div>
</div>
<div id=toast></div>
<script>
let data=null,hover=-1,regenCount=0;
const bevImg=new Image();
const color=(i,dark)=>`hsl(${(i*137)%360},85%,${dark?38:60}%)`;
function scale(){return bev.width/(data?data.grid:256);}
function draw(){
 const ctx=bev.getContext('2d');
 ctx.clearRect(0,0,bev.width,bev.height);
 if(bevImg.complete&&bevImg.width)ctx.drawImage(bevImg,0,0,bev.width,bev.height);
 if(!data)return;
 const s=scale();
 data.trajectories.forEach((t,i)=>{
  ctx.strokeStyle=color(i,i===hover);ctx.fillStyle=ctx.strokeStyle;
  ctx.lineWidth=i===hover?4:2;
  ctx.beginPath();
  t.forEach((p,k)=>{const x=p[1]*s,y=p[0]*s;k?ctx.lineTo(x,y):ctx.moveTo(x,y);});
  ctx.stroke();
  t.forEach(p=>{ctx.beginPath();ctx.arc(p[1]*s,p[0]*s,i===hover?3:2,0,7);ctx.fill();});
  const e=t[t.length-1];
  ctx.font='bold 16px sans-serif';ctx.fillStyle='#fff';
  ctx.fillText(String(i),e[1]*s+6,e[0]*s-6);
 });
}
function setHover(i){
 hover=i;draw();
 document.querySelectorAll('#ranks li').forEach(li=>
  li.classList.toggle('hi',+li.dataset.i===i));
}
bev.addEventListener('mousemove',e=>{
 if(!data)return;
 const r=bev.getBoundingClientRect(),s=scale();
 const mx=e.clientX-r.left,my=e.clientY-r.top;
 let best=-1,bd=144;
 data.trajectories.forEach((t,i)=>t.forEach(p=>{
  const d=(p[1]*s-mx)**2+(p[0]*s-my)**2;if(d<bd){bd=d;best=i;}}));
 if(best!==hover)setHover(best);
});
function buildList(){
 ranks.innerHTML='';
 data.trajectories.forEach((t,i)=>{
  const li=document.createElement('li');
  li.textContent=`trajectory ${i}`+(data.distances?
   ` — hausdorff ${data.distances[i].toFixed(2)}`:'');
  li.draggable=true;li.dataset.i=i;li.style.borderLeftColor=color(i);
  li.onmouseover=()=>setHover(i);li.onmouseout=()=>setHover(-1);
  ranks.appendChild(li);});
 let drag=null;
 ranks.querySelectorAll('li').forEach(li=>{li.ondragstart=()=>drag=li;
  li.ondragover=e=>e.preventDefault();
  li.ondrop=e=>{e.preventDefault();ranks.insertBefore(drag,li);};});
}
function apply(d){
 data=d;hover=-1;
 seq.value=d.seq;frame.value=d.frame;
 if(d.index!==undefined&&d.index!==null)idx.value=d.index;
 document.getElementById('seq-frame-display').textContent=
  `Sample Index: ${d.index??'N/A'}  Sequence: ${d.seq}, Frame: ${d.frame}`;
 bevImg.onload=draw;
 bevImg.src='data:image/png;base64,'+d.image;
 if(d.front_image){front.style.display='block';
  front.src='data:image/png;base64,'+d.front_image;}
 else front.style.display='none';
 buildList();draw();
}
async function fetchLoad(q){
 const r=await fetch('/load?'+q);
 if(!r.ok){toastMsg('load failed','#b33');return;}
 apply(await r.json());
}
function load(){regenCount=0;fetchLoad(`seq=${seq.value}&frame=${frame.value}`);}
function nextSample(){regenCount=0;fetchLoad('index=-1');}
function gotoIndex(){if(idx.value!=='')
 {regenCount=0;fetchLoad(`index=${idx.value}`);}}
function regen(){regenCount++;
 fetchLoad(`seq=${seq.value}&frame=${frame.value}&regen=${regenCount}`);}
function toastMsg(m,bg){const t=document.getElementById('toast');
 t.textContent=m;if(bg)t.style.background=bg;t.style.display='block';
 setTimeout(()=>t.style.display='none',1200);}
async function save(){
 const order=[...ranks.children].map(li=>+li.dataset.i);
 const r=await fetch('/save',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify({seq:seq.value,frame:frame.value,order:order,
   trajectories:data.trajectories})});
 const d=await r.json();
 toastMsg(`Seq ${seq.value}, Frame ${frame.value} saved!`,'#2e7d32');
}
</script></body></html>"""


class AnnotationBackend:
    """Framework-facing logic, servable + unit-testable without HTTP."""

    def __init__(self, data_root: str, grid: int = 256,
                 map_range: float = 12.8, horizon: int = 50,
                 num_candidates: int = 6, sampler: str = "epsilon",
                 epsilon: float = 2.0):
        self.root = data_root
        self.grid = grid
        self.map_range = map_range
        self.res = 2 * map_range / grid
        self.horizon = horizon
        self.n = num_candidates
        self.sampler = sampler
        self.epsilon = epsilon
        self._dataset = None  # built lazily once; /load reuses pose caches
        self._cursor = -1  # sample-index navigation state (/load?index=-1)

    def _ds(self):
        from creste_public_tpu_torch.data.coda_dataset import CodaDataset

        if self._dataset is None:
            self._dataset = CodaDataset(
                {"root": self.root, "grid": self.grid,
                 "map_range": self.map_range, "horizon": self.horizon},
                split="train", device="cpu",  # poses and the PIL front view
            )
        return self._dataset

    def _expert(self, seq: str, frame: int) -> np.ndarray:
        pose = self._ds()._traversability(seq, frame)  # [T, 3, 3]
        return pose[:, :2, 2]  # (row, col)

    def resolve_index(self, index: int) -> tuple[int, str, int]:
        """Sample-index navigation (reference /load?index=N,
        plot_trajectories.js loadNextTrajectory): index >= 0 selects
        dataset sample N; index == -1 advances past the last served
        sample ("Next Sample"). Returns (index, seq, frame)."""
        infos = self._ds().infos
        if index == -1:
            index = (self._cursor + 1) % len(infos)
        if not 0 <= index < len(infos):
            raise IndexError(f"sample index {index} out of range "
                             f"[0, {len(infos)})")
        self._cursor = index
        seq, frame = infos[index]
        return index, str(seq), int(frame)

    def _front_image(self, seq: str, frame: int) -> str | None:
        """Base64 camera view for the sample (reference front-image pane);
        None when the raw image is absent (BEV-only trees)."""
        try:
            rgb = self._ds()._image(seq, frame)
        except Exception:
            return None
        import io as _io

        from PIL import Image

        buf = _io.BytesIO()
        Image.fromarray(np.asarray(rgb, np.uint8)).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def load(self, seq: str, frame: int, regen: int = 0,
             index: int | None = None) -> dict:
        if index is not None:
            index, seq, frame = self.resolve_index(index)
        expert_rc = self._expert(seq, frame)
        expert_xy = ctl.bev_to_metric(
            expert_rc, (self.map_range, self.map_range), self.res
        )
        # regen > 0 resamples the candidate set with a fresh seed
        # (reference "Regenerate Trajectories": /load?...&regen=1 draws
        # new rollouts for the same frame); regen == 0 is deterministic
        # per frame so reloading a sample shows the same candidates.
        seed = frame if regen == 0 else frame ^ (0x9E3779B9 * regen)
        if self.sampler == "epsilon":
            cands = ctl.sample_epsilon_trajectories(
                expert_xy, self.n, self.horizon, epsilon=self.epsilon,
                seed=seed,
            )
        else:
            cands = ctl.sample_unicycle_trajectories(
                self.n, self.horizon, seed=seed
            )
        all_traj = np.concatenate(
            [expert_xy[None, :, :], cands[:, :, :2]], axis=0
        )
        dists = ctl.hausdorff_distances(all_traj)
        rc = ctl.metric_to_bev(
            all_traj, (self.map_range, self.map_range), self.res
        )
        img = self._render(rc)
        return {
            "trajectories": rc.tolist(),
            "distances": dists.tolist(),
            "image": img,
            "front_image": self._front_image(seq, frame),
            "grid": self.grid,
            "seq": seq,
            "frame": frame,
            "index": index,
            "regen": regen,
        }

    def _render(self, trajs_rc: np.ndarray) -> str:
        from creste_public_tpu_torch.utils import visualization as vz

        img = np.full((self.grid, self.grid, 3), 30, np.uint8)
        colors = [(80, 220, 80)] + [(220, 80, 80)] * (len(trajs_rc) - 1)
        for t, c in zip(trajs_rc, colors):
            img = vz.overlay_trajectory(img, t, color=c)
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def save(self, payload: dict) -> str:
        seq, frame = str(payload["seq"]), int(payload["frame"])
        out_dir = os.path.join(self.root, "counterfactuals", seq)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{frame}.pkl")
        # Explicit contract (a permutation heuristic would corrupt honest
        # rank payloads, which are also permutations): `order` is the drag
        # ORDER (order[pos] = trajectory index; the built-in frontend
        # posts this) and is inverted to per-trajectory rank VALUES
        # (rank[i] = rank of trajectory i, 0 = best — reference
        # app.py:201-225; MaxEntIRLLoss/TREXLoss treat rank element-wise);
        # `rank` is already rank values and stored verbatim.
        if "order" in payload:
            raw = [int(r) for r in payload["order"]]
            if sorted(raw) != list(range(len(raw))):
                raise ValueError(f"order must be a permutation, got {raw}")
            rank = [0] * len(raw)
            for pos, traj_idx in enumerate(raw):
                rank[traj_idx] = pos
        else:
            rank = [int(r) for r in payload["rank"]]
        record = {
            "trajectories": [np.asarray(t) for t in payload["trajectories"]],
            "rank": rank,
            "seq": seq,
            "frame": frame,
        }
        with open(path, "wb") as f:
            pickle.dump(record, f)
        return path


def make_handler(backend: AnnotationBackend):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/load":
                q = parse_qs(url.query)
                index = (int(q["index"][0]) if "index" in q else None)
                try:
                    self._json(
                        backend.load(q.get("seq", ["0"])[0],
                                     int(q.get("frame", ["0"])[0]),
                                     regen=int(q.get("regen", ["0"])[0]),
                                     index=index)
                    )
                except IndexError as e:
                    self._json({"error": str(e)}, 404)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if urlparse(self.path).path != "/save":
                return self._json({"error": "not found"}, 404)
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n))
            path = backend.save(payload)
            self._json({"saved": path})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def serve(data_root: str, port: int = 4242, host: str = "0.0.0.0",
          **kwargs) -> None:
    backend = AnnotationBackend(data_root, **kwargs)
    server = HTTPServer((host, port), make_handler(backend))
    print(f"annotation app on http://localhost:{port} (root={data_root})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv: list[str] | None = None) -> None:
    """The app's command line (scripts/traversability/rlhf_app.py)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--port", type=int, default=4242)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--sampler", choices=["epsilon", "unicycle"],
                    default="epsilon")
    ap.add_argument("--num_candidates", type=int, default=5,
                    help="candidates per frame; expert + candidates must "
                         "fit the dataset's n_counterfactuals pad (6)")
    args = ap.parse_args(argv)
    serve(args.root, port=args.port, host=args.host, sampler=args.sampler,
          num_candidates=args.num_candidates)


if __name__ == "__main__":
    main()
