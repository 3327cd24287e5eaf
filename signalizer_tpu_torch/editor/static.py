"""The browser editor app (single self-contained HTML page).

A copy of :mod:`signalizer_tpu.editor.static`: the same page, served by
the port's editor server.

Renderer-side counterpart of the reference's editor shell: the tab bar
with auto-hide (ref: MainEditor.h:68-69 — 1 s hide delay, reappear on
mouse move), one active view canvas (line graph / oscilloscope /
vectorscope / spectrogram draw the SAME render-ready arrays the
matplotlib viewer consumes), the per-view editor pages (icon tabs of
matrix sections, ref: SignalizerDesign.h CContentPage/MatrixSection),
the preset widget, global render settings, and the node-graph editor
with drag-to-connect (ref: GraphEditor.cpp:625 connectionRequest).

Plain ES2017, no external assets — the page is served by
:mod:`signalizer_tpu_torch.editor.server` and talks to its JSON API.
"""

INDEX_HTML = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>signalizer_tpu editor</title>
<style>
  :root {
    --bg: #1b1b1b; --panel: #282828; --sep: #4b4b4b; --text: #d8d8b4;
    --aux: #808080; --sel: #99995f; --accent: #5f9ea0;
  }
  html, body { margin: 0; height: 100%; background: var(--bg);
    color: var(--text); font: 12px/1.4 system-ui, sans-serif; overflow: hidden; }
  #root { display: flex; height: 100%; }
  #viewwrap { flex: 1; display: flex; flex-direction: column; min-width: 0; }
  #tabs { display: flex; gap: 2px; padding: 4px 6px; background: var(--panel);
    transition: margin-top .3s; z-index: 5; }
  #tabs.hidden { margin-top: -30px; }
  .tab { padding: 3px 14px; cursor: pointer; border-radius: 3px 3px 0 0;
    color: var(--aux); background: #222; user-select: none; }
  .tab.sel { color: var(--sel); background: #333; }
  .tab:hover { color: var(--text); }
  #status { margin-left: auto; color: var(--aux); font-size: 11px;
    align-self: center; white-space: nowrap; }
  #view { flex: 1; position: relative; min-height: 0; }
  canvas { position: absolute; inset: 0; width: 100%; height: 100%; }
  #panel { width: 290px; background: var(--panel); border-left: 1px solid var(--sep);
    display: flex; flex-direction: column; transition: width .3s; }
  #panel.hidden { width: 0; overflow: hidden; }
  #pagetabs { display: flex; gap: 2px; padding: 4px; }
  .ptab { flex: 1; text-align: center; padding: 3px; cursor: pointer;
    background: #222; color: var(--aux); border-radius: 3px; }
  .ptab.sel { color: var(--sel); background: #383838; }
  #pagebody { flex: 1; overflow-y: auto; padding: 4px 8px 20px; }
  .section { border: 1px solid var(--sep); border-radius: 4px; margin: 6px 0;
    padding: 4px 6px 6px; }
  .section h4 { margin: 0 0 4px; color: var(--aux); font-size: 11px;
    text-transform: uppercase; letter-spacing: .05em; }
  .grid { display: grid; grid-template-columns: 1fr 1fr; gap: 4px 8px; }
  .widget { min-width: 0; }
  .widget label { display: block; color: var(--aux); font-size: 10px;
    white-space: nowrap; overflow: hidden; text-overflow: ellipsis; }
  .widget input[type=range] { width: 100%; accent-color: var(--accent); }
  .widget input[type=text], .widget select {
    width: 100%; background: #1e1e1e; color: var(--text);
    border: 1px solid var(--sep); border-radius: 2px; font-size: 11px;
    box-sizing: border-box; }
  .widget input[type=color] { width: 100%; height: 20px; border: none;
    background: none; padding: 0; }
  .widget input[type=checkbox] { accent-color: var(--accent); }
  .w-knob .val { color: var(--text); font-size: 10px; cursor: pointer; }
  button { background: #333; color: var(--text); border: 1px solid var(--sep);
    border-radius: 3px; cursor: pointer; font-size: 11px; padding: 2px 8px; }
  button:hover { background: #3d3d3d; }
  #graphcanvas { background: #161616; }
  .hint { color: var(--aux); font-size: 10px; padding: 2px 0; }
</style>
</head>
<body>
<div id="root">
  <div id="viewwrap">
    <div id="tabs"></div>
    <div id="view"><canvas id="canvas"></canvas></div>
  </div>
  <div id="panel">
    <div id="pagetabs"></div>
    <div id="pagebody"></div>
  </div>
</div>
<script>
"use strict";
const $ = s => document.querySelector(s);
const api = {
  get: p => fetch(p).then(r => r.json()),
  post: (p, body) => fetch(p, {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify(body || {})})
      .then(r => r.json()),
};
const state = {
  tabs: [], tab: "spectrum", layout: null, page: 0, appState: null,
  lastFrame: null, lastMouse: Date.now(), sgImgTick: -1, sgImg: null,
  graph: null, drag: null, pollMs: 90,
};

// ---------------------------------------------------------------- tab bar
function renderTabs() {
  const bar = $("#tabs");
  bar.innerHTML = "";
  for (const t of state.tabs) {
    const el = document.createElement("div");
    el.className = "tab" + (t === state.tab ? " sel" : "");
    el.textContent = t;
    el.onclick = () => selectTab(t);
    bar.appendChild(el);
  }
  const status = document.createElement("div");
  status.id = "status";
  bar.appendChild(status);
}
function selectTab(t) {
  if (t === state.tab) t = "none";  // deselect -> idle view (CDefaultView)
  state.tab = t;
  state.layout = null;
  api.post("/api/settings", {selected_tab: state.tabs.indexOf(t)});
  renderTabs();
  loadPanel();
}

// auto-hide chrome (ref: MainEditor tab bar 1s/7s timeouts)
document.addEventListener("mousemove", () => { state.lastMouse = Date.now(); });
setInterval(() => {
  const s = state.appState;
  if (!s) return;
  const idle = Date.now() - state.lastMouse;
  $("#tabs").classList.toggle("hidden", s.hide_tabs && idle > 7000 && !s.kiosk);
  $("#panel").classList.toggle("hidden",
      (s.hide_widgets_on_mouse_exit && idle > 7000) || s.kiosk);
}, 500);

// ---------------------------------------------------------------- widgets
function widgetEl(setName, w) {
  const div = document.createElement("div");
  div.className = "widget w-" + w.kind;
  const label = document.createElement("label");
  label.textContent = w.name;
  label.title = w.exported || w.name;
  div.appendChild(label);
  const send = body => api.post("/api/param",
      Object.assign({set: setName, name: w.name}, body)).then(r => {
        if (r.display !== undefined && div._val) div._val.textContent = r.display;
        if (r.tier === "rebuild" || r.tier === "feed") state.layoutStale = true;
      });
  if (w.kind === "knob") {
    const range = document.createElement("input");
    range.type = "range"; range.min = 0; range.max = 1; range.step = 0.001;
    range.value = w.normalized;
    range.oninput = () => send({normalized: +range.value});
    const val = document.createElement("div");
    val.className = "val"; val.textContent = w.display;
    val.title = "click to type a value";
    val.onclick = () => {
      const t = prompt(w.name, w.display);
      if (t !== null) send({text: t}).then(() => loadPanel());
    };
    div._val = val;
    div.appendChild(range); div.appendChild(val);
  } else if (w.kind === "combo") {
    const sel = document.createElement("select");
    w.options.forEach((o, i) => {
      const opt = document.createElement("option");
      opt.value = i; opt.textContent = o; opt.selected = i === w.index;
      sel.appendChild(opt);
    });
    sel.onchange = () =>
        send({normalized: w.options.length < 2 ? 0 : sel.value / (w.options.length - 1)});
    div.appendChild(sel);
  } else if (w.kind === "toggle") {
    const cb = document.createElement("input");
    cb.type = "checkbox"; cb.checked = w.on;
    cb.onchange = () => send({normalized: cb.checked ? 1 : 0});
    div.appendChild(cb);
  } else if (w.kind === "colour") {
    const c = document.createElement("input");
    c.type = "color";
    c.value = "#" + w.rgba.slice(0, 3)
        .map(x => Math.round(x * 255).toString(16).padStart(2, "0")).join("");
    c.onchange = () => {
      const hex = c.value;
      ["R", "G", "B"].forEach((ch, i) => api.post("/api/param", {
        set: setName, name: w.name + "." + ch,
        normalized: parseInt(hex.substr(1 + 2 * i, 2), 16) / 255,
      }));
    };
    const a = document.createElement("input");
    a.type = "range"; a.min = 0; a.max = 1; a.step = 0.01; a.value = w.rgba[3];
    a.title = "alpha";
    a.oninput = () => api.post("/api/param",
        {set: setName, name: w.name + ".A", normalized: +a.value});
    div.appendChild(c); div.appendChild(a);
  } else if (w.kind === "bundle") {
    for (const m of w.members) {
      const sub = widgetEl(setName, Object.assign({}, m,
          {name: m.name}));
      div.appendChild(sub);
    }
  } else if (w.kind === "presets") {
    div.appendChild(presetWidget());
  } else if (w.kind === "tracker") {
    const d = document.createElement("div");
    d.className = "hint"; d.id = "trackerline"; d.textContent = "—";
    div.appendChild(d);
  }
  return div;
}

function presetWidget() {
  const wrap = document.createElement("div");
  const sel = document.createElement("select");
  const load = document.createElement("button"); load.textContent = "load";
  const name = document.createElement("input"); name.type = "text";
  name.placeholder = "preset name";
  const save = document.createElement("button"); save.textContent = "save";
  api.get("/api/presets").then(r => {
    for (const p of r.presets) {
      const o = document.createElement("option"); o.textContent = p;
      sel.appendChild(o);
    }
  });
  load.onclick = () => api.post("/api/presets/load", {name: sel.value})
      .then(() => loadPanel());
  save.onclick = () => name.value &&
      api.post("/api/presets/save", {name: name.value});
  wrap.appendChild(sel); wrap.appendChild(load);
  wrap.appendChild(name); wrap.appendChild(save);
  return wrap;
}

function loadPanel() {
  const body = $("#pagebody"), ptabs = $("#pagetabs");
  if (state.tab === "none") { ptabs.innerHTML = ""; body.innerHTML =
      '<div class="hint">no view selected - click a tab</div>'; return; }
  if (state.tab === "graph") { ptabs.innerHTML = ""; body.innerHTML =
      '<div class="hint">drag pin to pin to connect - click an edge to remove<br>' +
      'double-click the host node to rename</div>'; return; }
  if (state.tab === "global") { ptabs.innerHTML = ""; renderGlobalPage(body); return; }
  api.get("/api/layout/" + state.tab).then(l => {
    state.layout = l;
    if (state.page >= l.pages.length) state.page = 0;
    ptabs.innerHTML = "";
    l.pages.forEach((p, i) => {
      const el = document.createElement("div");
      el.className = "ptab" + (i === state.page ? " sel" : "");
      el.textContent = p.name || p.icon;
      el.onclick = () => { state.page = i; loadPanel(); };
      ptabs.appendChild(el);
    });
    body.innerHTML = "";
    const page = l.pages[state.page];
    for (const s of page.sections) {
      const sec = document.createElement("div");
      sec.className = "section";
      if (s.name) {
        const h = document.createElement("h4"); h.textContent = s.name;
        sec.appendChild(h);
      }
      const grid = document.createElement("div");
      grid.className = "grid";
      const cols = [[], []];
      for (const c of s.controls) cols[Math.min(c.column, 1)].push(c);
      const n = Math.max(cols[0].length, cols[1].length);
      for (let i = 0; i < n; i++) for (const col of cols) {
        const cell = document.createElement("div");
        if (col[i]) cell.appendChild(widgetEl(l.set, col[i]));
        grid.appendChild(cell);
      }
      sec.appendChild(grid);
      body.appendChild(sec);
    }
  });
}

function renderGlobalPage(body) {
  const s = state.appState || {};
  body.innerHTML = "";
  const sec = document.createElement("div");
  sec.className = "section";
  sec.innerHTML = "<h4>render settings</h4>";
  const mk = (label, el) => {
    const d = document.createElement("div"); d.className = "widget";
    const l = document.createElement("label"); l.textContent = label;
    d.appendChild(l); d.appendChild(el); sec.appendChild(d);
  };
  const rr = document.createElement("input");
  rr.type = "range"; rr.min = 10; rr.max = 1000; rr.value = s.refresh_rate_ms || 80;
  rr.onchange = () => api.post("/api/settings", {refresh_rate_ms: +rr.value})
      .then(r => { state.appState = r; state.pollMs = Math.max(30, r.refresh_rate_ms); });
  mk("refresh rate (ms)", rr);
  for (const key of ["hide_tabs", "hide_widgets_on_mouse_exit", "kiosk", "vsync"]) {
    const cb = document.createElement("input");
    cb.type = "checkbox"; cb.checked = !!s[key];
    cb.onchange = () => api.post("/api/settings", {[key]: cb.checked})
        .then(r => state.appState = r);
    mk(key.replace(/_/g, " "), cb);
  }
  const fr = document.createElement("button");
  fr.textContent = s.freeze ? "unfreeze" : "freeze";
  fr.onclick = () => api.post("/api/freeze", {}).then(() => refreshState());
  mk("freeze display", fr);
  const gs = document.createElement("select");
  for (const [i, label] of [[0, "save graph fully"],
      [1, "ignore graph this session"], [2, "never save graph"]]) {
    const o = document.createElement("option");
    o.value = i; o.textContent = label;
    if (i === (s.graph_serialization || 0)) o.selected = true;
    gs.appendChild(o);
  }
  gs.onchange = () => api.post("/api/settings",
      {graph_serialization: +gs.value}).then(r => state.appState = r);
  mk("preset graph saving", gs);
  const ex = document.createElement("button");
  ex.textContent = "reveal exception log";
  ex.onclick = () => api.get("/api/exceptions").then(r => {
    let pre = $("#exlog");
    if (!pre) {
      pre = document.createElement("pre");
      pre.id = "exlog"; pre.className = "hint";
      ex.parentElement.appendChild(pre);
    }
    pre.textContent = r.path + " (" + r.size_bytes + " bytes)\n" +
        (r.tail || "(empty)");
  });
  mk("exception log", ex);
  body.appendChild(sec);
  const cs = document.createElement("div");
  cs.className = "section";
  cs.innerHTML = "<h4>colour scheme</h4>";
  for (const [name, rgba] of Object.entries(s.colour_scheme || {})) {
    const d = document.createElement("div"); d.className = "widget";
    const l = document.createElement("label"); l.textContent = name;
    const c = document.createElement("input"); c.type = "color";
    c.value = "#" + rgba.slice(0, 3)
        .map(x => Math.round(x * 255).toString(16).padStart(2, "0")).join("");
    c.onchange = () => {
      const hex = c.value;
      const nrgba = [1, 3, 5].map(i => parseInt(hex.substr(i, 2), 16) / 255);
      nrgba.push(rgba[3]);
      api.post("/api/settings", {colour: {name, rgba: nrgba}})
          .then(r => { state.appState = r; applyScheme(r.colour_scheme); });
    };
    d.appendChild(l); d.appendChild(c); cs.appendChild(d);
  }
  body.appendChild(cs);
}
function applyScheme(scheme) {
  if (!scheme) return;
  const css = (k, v) => v && document.documentElement.style.setProperty(k,
      "rgb(" + v.slice(0, 3).map(x => Math.round(x * 255)).join(",") + ")");
  css("--bg", scheme["Deactivated"]); css("--panel", scheme["Normal"]);
  css("--sep", scheme["Separator"]); css("--text", scheme["Control Text"]);
  css("--aux", scheme["Auxillary Text"]); css("--sel", scheme["Selected Text"]);
}

// ---------------------------------------------------------------- canvas
const canvas = $("#canvas");
const ctx = canvas.getContext("2d");
function fit() {
  const r = canvas.parentElement.getBoundingClientRect();
  canvas.width = r.width * devicePixelRatio;
  canvas.height = r.height * devicePixelRatio;
}
window.addEventListener("resize", fit);
const rgba = c => "rgba(" + Math.round(c[0] * 255) + "," + Math.round(c[1] * 255) +
    "," + Math.round(c[2] * 255) + "," + (c.length > 3 ? c[3] : 1) + ")";

// ------------------------------------------------------ default (idle) view
// ref: CDefaultView, SignalizerDesign.h:437-617 — bouncing "No view
// selected" text on a black canvas; the colour re-randomizes on every
// wall collision (the JUCE glow becomes a canvas shadow), moving 1 px
// per `speed` ms with fractional-move accumulation so the animation is
// frame-rate independent (repaintMainContent2's fractionateMoves math).
const dflt = {x: null, y: null, vx: 1, vy: 1, colour: "#888", last: 0,
              frac: 0, speed: 10, text: "No view selected"};
function dfltCollide() {
  const r = () => Math.floor(Math.random() * 256);
  dflt.colour = "rgb(" + r() + "," + r() + "," + r() + ")";
}
function drawDefaultView() {
  const w = canvas.width, h = canvas.height;
  ctx.fillStyle = "#000"; ctx.fillRect(0, 0, w, h);
  const fs = 20 * devicePixelRatio;
  ctx.font = fs + "px sans-serif";
  const tw = ctx.measureText(dflt.text).width, th = fs;
  if (dflt.x === null) {  // first paint: random start (ref resized())
    dflt.x = Math.random() * Math.max(1, w - tw);
    dflt.y = Math.random() * Math.max(1, h - th);
    dflt.last = Date.now();
    dfltCollide();
  }
  const now = Date.now();
  const precise = dflt.frac + (now - dflt.last) / dflt.speed;
  let moves = Math.floor(precise);
  dflt.frac = precise - moves;
  dflt.last = now;
  while (moves-- > 0) {
    dflt.x += dflt.vx; dflt.y += dflt.vy;
    let hit = false;
    if (dflt.x + tw >= w) { dflt.vx = -dflt.vx; dflt.x = w - tw; hit = true; }
    if (dflt.y + th >= h) { dflt.vy = -dflt.vy; dflt.y = h - th; hit = true; }
    if (dflt.x <= 0) { dflt.vx = -dflt.vx; dflt.x = 0; hit = true; }
    if (dflt.y <= 0) { dflt.vy = -dflt.vy; dflt.y = 0; hit = true; }
    if (hit) dfltCollide();
  }
  ctx.shadowColor = dflt.colour; ctx.shadowBlur = 8 * devicePixelRatio;
  ctx.fillStyle = dflt.colour;
  ctx.textBaseline = "top";
  ctx.fillText(dflt.text, dflt.x, dflt.y);
  ctx.shadowBlur = 0; ctx.textBaseline = "alphabetic";
}

function drawSpectrum(f) {
  const W = canvas.width, H = canvas.height;
  ctx.fillStyle = f.background ? rgba(f.background) : "#000";
  ctx.fillRect(0, 0, W, H);
  if (f.grid) {
    ctx.strokeStyle = rgba(f.grid_colour || [0.5, 0.5, 0.5, 0.4]);
    ctx.lineWidth = 1; ctx.globalAlpha = 0.4;
    ctx.fillStyle = ctx.strokeStyle; ctx.font = (10 * devicePixelRatio) + "px sans-serif";
    for (const g of f.grid) {
      const x = g.p * W;
      ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, H); ctx.stroke();
      ctx.fillText(g.label, x + 2, H - 4);
    }
    for (const g of f.db_grid) {
      const y = (1 - g.p) * H;
      ctx.beginPath(); ctx.moveTo(0, y); ctx.lineTo(W, y); ctx.stroke();
      ctx.fillText(g.label, 2, y - 2);
    }
    ctx.globalAlpha = 1;
  }
  for (const fl of (f.floods || [])) {
    ctx.fillStyle = rgba(fl.colour);
    ctx.beginPath();
    const n = fl.top.length;
    ctx.moveTo(0, (1 - fl.end[0]) * H);
    for (let i = 0; i < n; i++) ctx.lineTo(i / (n - 1) * W, (1 - fl.top[i]) * H);
    for (let i = n - 1; i >= 0; i--) ctx.lineTo(i / (n - 1) * W, (1 - fl.end[i]) * H);
    ctx.fill();
  }
  // fallback when no line-graph feed is attached: raw display rows
  for (const row of (f.rows || [])) {
    ctx.strokeStyle = "#7a7";
    ctx.lineWidth = devicePixelRatio;
    ctx.beginPath();
    for (let i = 0; i < row.length; i++) {
      const x = i / (row.length - 1) * W, y = (1 - row[i]) * H;
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    }
    ctx.stroke();
  }
  for (const s of (f.strips || [])) {
    ctx.strokeStyle = rgba(s.colour);
    ctx.lineWidth = Math.max(1, (f.primitive_size || 1) * devicePixelRatio);
    ctx.beginPath();
    const n = s.y.length;
    for (let i = 0; i < n; i++) {
      const x = i / (n - 1) * W, y = (1 - s.y[i]) * H;
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    }
    ctx.stroke();
  }
  if (f.tracker && f.tracker.frequency) {
    ctx.fillStyle = "#fff";
    ctx.font = (11 * devicePixelRatio) + "px sans-serif";
    ctx.fillText(f.tracker.frequency.toFixed(1) + " Hz  " +
        (f.tracker.dbs !== undefined ? f.tracker.dbs.toFixed(1) + " dB  " : "") +
        (f.tracker.note || ""), 8 * devicePixelRatio, 16 * devicePixelRatio);
    const t = $("#trackerline");
    if (t) t.textContent = f.tracker.frequency.toFixed(1) + " Hz " + (f.tracker.note || "");
  }
}

function drawOscilloscope(f) {
  const W = canvas.width, H = canvas.height;
  const h = f.hints || {};
  ctx.fillStyle = h.background_colour ? rgba(h.background_colour) : "#000";
  ctx.fillRect(0, 0, W, H);
  const [pairs, rows, P] = f.shape;
  const overlay = !!h.overlay_channels;
  const lanes = overlay ? 1 : rows;
  const colours = Uint8Array.from(atob(f.colours_u8), c => c.charCodeAt(0));
  for (let r = 0; r < rows; r++) {
    const lane = overlay ? 0 : r;
    const y0 = lane * H / lanes, hh = H / lanes;
    const Y = v => y0 + (1 - (v + 1) / 2) * hh;
    for (let p = 0; p < pairs; p++) {
      ctx.globalAlpha = 0.18;
      ctx.fillStyle = "#4af";
      ctx.beginPath();
      ctx.moveTo(0, Y(f.env_min[p][r][0]));
      for (let i = 0; i < P; i++) ctx.lineTo(i / (P - 1) * W, Y(f.env_max[p][r][i]));
      for (let i = P - 1; i >= 0; i--) ctx.lineTo(i / (P - 1) * W, Y(f.env_min[p][r][i]));
      ctx.fill();
      ctx.globalAlpha = 1;
      ctx.lineWidth = Math.max(1, (h.primitive_size || 1) * devicePixelRatio);
      // per-pixel spectral colouring: stroke in short segments
      const base = (p * rows + r) * P * 3;
      let seg = 16;
      for (let i = 0; i < P - 1; i += seg) {
        const j = Math.min(i + seg, P - 1);
        const ci = base + i * 3;
        ctx.strokeStyle = "rgb(" + colours[ci] + "," + colours[ci + 1] + "," +
            colours[ci + 2] + ")";
        ctx.beginPath();
        for (let k = i; k <= j; k++)
          ctx.lineTo(k / (P - 1) * W, Y(f.waveform[p][r][k]));
        ctx.stroke();
      }
    }
    if (!overlay) {
      ctx.strokeStyle = "#444";
      ctx.beginPath(); ctx.moveTo(0, y0 + hh); ctx.lineTo(W, y0 + hh); ctx.stroke();
    }
  }
  ctx.fillStyle = "#999"; ctx.font = (10 * devicePixelRatio) + "px sans-serif";
  ctx.fillText("gain " + f.gain[0].toFixed(2) +
      (f.fundamental[0] ? "  f0 " + f.fundamental[0].toFixed(1) + " Hz" : "") +
      (f.trigger_found[0] ? "  trig" : ""), 8 * devicePixelRatio, 14 * devicePixelRatio);
}

function drawVectorscope(f) {
  const W = canvas.width, H = canvas.height;
  const h = f.hints || {};
  ctx.fillStyle = h.background_colour ? rgba(h.background_colour) : "#000";
  ctx.fillRect(0, 0, W, H);
  const S = Math.min(W, H) / 2.4, cx = W / 2, cy = H / 2;
  ctx.strokeStyle = "#333";
  ctx.beginPath(); ctx.moveTo(cx - S, cy); ctx.lineTo(cx + S, cy);
  ctx.moveTo(cx, cy - S); ctx.lineTo(cx, cy + S); ctx.stroke();
  const wf = h.waveform_colour || [0.2, 0.8, 0.3, 1];
  const fade = h.fade_older_points !== false;
  const pairsArr = f.vertices;
  for (let p = 0; p < pairsArr.length; p++) {
    const pts = pairsArr[p];
    if (h.interconnect_samples) {
      ctx.strokeStyle = rgba(wf); ctx.lineWidth = devicePixelRatio;
      ctx.beginPath();
      for (let i = 0; i < pts.length; i++)
        ctx.lineTo(cx + pts[i][0] * S, cy - pts[i][1] * S);
      ctx.stroke();
    } else {
      for (let i = 0; i < pts.length; i++) {
        const age = fade ? Math.max(0, Math.min(1, pts[i][2] + 1)) : 1;
        ctx.fillStyle = "rgba(" + Math.round(wf[0] * 255 * age) + "," +
            Math.round(wf[1] * 255 * age) + "," + Math.round(wf[2] * 255 * age) + ",0.7)";
        ctx.fillRect(cx + pts[i][0] * S, cy - pts[i][1] * S,
            devicePixelRatio * (h.primitive_size ? h.primitive_size * 10 : 1.5),
            devicePixelRatio * (h.primitive_size ? h.primitive_size * 10 : 1.5));
      }
    }
  }
  // stereo meters (balance + correlation, quick/slow)
  const mc = h.meter_colour || [0.4, 0.7, 1, 1];
  const bars = [["bal", f.balance[0]], ["cor", f.correlation[0]]];
  bars.forEach(([name, pairVals], bi) => {
    pairVals.forEach((v, si) => {
      const y = H - (28 - 12 * si) * devicePixelRatio - bi * 34 * devicePixelRatio;
      ctx.fillStyle = "#222";
      ctx.fillRect(cx - S, y, 2 * S, 8 * devicePixelRatio);
      ctx.fillStyle = rgba(mc);
      ctx.globalAlpha = si ? 0.5 : 1;
      ctx.fillRect(cx - S, y, 2 * S * v, 8 * devicePixelRatio);
      ctx.globalAlpha = 1;
    });
    ctx.fillStyle = "#888"; ctx.font = (9 * devicePixelRatio) + "px sans-serif";
    ctx.fillText(name, cx - S - 22 * devicePixelRatio,
        H - 22 * devicePixelRatio - bi * 34 * devicePixelRatio);
  });
}

function drawSpectrogram(f) {
  const W = canvas.width, H = canvas.height;
  ctx.fillStyle = "#000"; ctx.fillRect(0, 0, W, H);
  if (state.sgImgTick !== f.image_tick) {
    state.sgImgTick = f.image_tick;
    const img = new Image();
    img.onload = () => { state.sgImg = img; };
    img.src = "/api/spectrogram.png?t=" + f.image_tick;
  }
  if (state.sgImg) {
    ctx.imageSmoothingEnabled = false;
    ctx.drawImage(state.sgImg, 0, 0, W, H);
  }
}

// ---------------------------------------------------------------- graph
function drawGraph() {
  const W = canvas.width, H = canvas.height;
  ctx.fillStyle = "#161616"; ctx.fillRect(0, 0, W, H);
  const g = state.graph;
  if (!g) return;
  const nodes = g.nodes;
  const pos = {};
  nodes.forEach((n, i) => {
    pos[n.id] = {
      x: W * (0.2 + 0.6 * (i % 3) / 2),
      y: H * (0.25 + 0.5 * Math.floor(i / 3) / Math.max(1, Math.ceil(nodes.length / 3) - 1 || 1)),
    };
  });
  state.graphPos = pos;
  // edges as beziers pin-to-pin
  ctx.lineWidth = 2 * devicePixelRatio;
  for (const e of g.edges) {
    const a = pos[e.src], b = pos[e.dst];
    if (!a || !b) continue;
    const ax = a.x + 60 * devicePixelRatio, ay = a.y + (e.src_ch * 14 - 7) * devicePixelRatio;
    const bx = b.x - 60 * devicePixelRatio, by = b.y + (e.dst_ch * 14 - 7) * devicePixelRatio;
    ctx.strokeStyle = "#5f9ea0";
    ctx.beginPath(); ctx.moveTo(ax, ay);
    ctx.bezierCurveTo(ax + 60 * devicePixelRatio, ay, bx - 60 * devicePixelRatio, by, bx, by);
    ctx.stroke();
  }
  for (const n of nodes) {
    const p = pos[n.id];
    const wNode = 120 * devicePixelRatio, hNode = 50 * devicePixelRatio;
    ctx.fillStyle = n.id === g.self ? "#2e3c3c" : "#2b2b2b";
    ctx.strokeStyle = n.id === g.self ? "#5f9ea0" : "#555";
    ctx.beginPath();
    if (ctx.roundRect)
      ctx.roundRect(p.x - wNode / 2, p.y - hNode / 2, wNode, hNode, 6 * devicePixelRatio);
    else
      ctx.rect(p.x - wNode / 2, p.y - hNode / 2, wNode, hNode);
    ctx.fill(); ctx.stroke();
    ctx.fillStyle = "#ccc"; ctx.font = (11 * devicePixelRatio) + "px sans-serif";
    ctx.textAlign = "center";
    ctx.fillText(n.name, p.x, p.y - 8 * devicePixelRatio);
    ctx.font = (9 * devicePixelRatio) + "px sans-serif"; ctx.fillStyle = "#888";
    ctx.fillText(n.channels + " ch", p.x, p.y + 6 * devicePixelRatio);
    ctx.textAlign = "start";
    // pins: outputs right, inputs left
    for (let c = 0; c < n.channels; c++) {
      const py = p.y + (c * 14 - 7) * devicePixelRatio;
      ctx.fillStyle = "#5f9ea0";
      ctx.beginPath();
      ctx.arc(p.x + wNode / 2, py, 4 * devicePixelRatio, 0, 7); ctx.fill();
      if (n.id === g.self) {
        ctx.beginPath();
        ctx.arc(p.x - wNode / 2, py, 4 * devicePixelRatio, 0, 7); ctx.fill();
      }
    }
  }
  if (state.drag) {
    ctx.strokeStyle = "#aaa";
    ctx.setLineDash([4, 4]);
    ctx.beginPath();
    ctx.moveTo(state.drag.x0, state.drag.y0);
    ctx.lineTo(state.drag.x1, state.drag.y1);
    ctx.stroke();
    ctx.setLineDash([]);
  }
}
function graphHit(x, y) {
  const g = state.graph, pos = state.graphPos || {};
  if (!g) return null;
  for (const n of g.nodes) {
    const p = pos[n.id];
    if (!p) continue;
    for (let c = 0; c < n.channels; c++) {
      const py = p.y + (c * 14 - 7) * devicePixelRatio;
      for (const side of [1, -1]) {
        const px = p.x + side * 60 * devicePixelRatio;
        if ((x - px) ** 2 + (y - py) ** 2 < (10 * devicePixelRatio) ** 2)
          return {node: n, ch: c, out: side > 0, x: px, y: py};
      }
    }
    if (Math.abs(x - p.x) < 60 * devicePixelRatio &&
        Math.abs(y - p.y) < 25 * devicePixelRatio)
      return {node: n, body: true};
  }
  return null;
}
canvas.addEventListener("mousedown", e => {
  if (state.tab !== "graph") return;
  const x = e.offsetX * devicePixelRatio, y = e.offsetY * devicePixelRatio;
  const hit = graphHit(x, y);
  if (hit && !hit.body)
    state.drag = {from: hit, x0: hit.x, y0: hit.y, x1: x, y1: y};
});
canvas.addEventListener("mousemove", e => {
  if (state.drag) {
    state.drag.x1 = e.offsetX * devicePixelRatio;
    state.drag.y1 = e.offsetY * devicePixelRatio;
  } else if (state.tab === "spectrum") {
    const now = Date.now();
    if (now - (state.lastCursorPost || 0) > 100) {
      state.lastCursorPost = now;
      api.post("/api/cursor", {fraction: e.offsetX / canvas.clientWidth});
    }
  }
});
canvas.addEventListener("mouseup", e => {
  if (!state.drag) return;
  const x = e.offsetX * devicePixelRatio, y = e.offsetY * devicePixelRatio;
  const to = graphHit(x, y);
  const from = state.drag.from;
  state.drag = null;
  if (to && !to.body && from.node.id !== to.node.id) {
    // connect source-node output pin -> host input pin (either direction)
    const src = from.out ? from : to, dst = from.out ? to : from;
    api.post("/api/graph/connect",
        {src: src.node.id, src_ch: src.ch, dst_ch: dst.ch})
        .then(r => state.graph = r);
  }
});
canvas.addEventListener("dblclick", e => {
  if (state.tab !== "graph") return;
  const hit = graphHit(e.offsetX * devicePixelRatio, e.offsetY * devicePixelRatio);
  if (hit && hit.body && hit.node.id === state.graph.self) {
    const name = prompt("rename node", hit.node.name);
    if (name) api.post("/api/graph/rename", {name}).then(r => state.graph = r);
  } else if (hit && hit.body) {
    api.post("/api/graph/toggle", {src: hit.node.id}).then(r => state.graph = r);
  }
});

// ---------------------------------------------------------------- main loop
async function refreshState() {
  const s = await api.get("/api/state");
  state.appState = s;
  state.pollMs = Math.max(30, s.refresh_rate_ms);
  if (!state.tabs.length) {
    state.tabs = s.tabs;
    state.tab = s.selected_tab < 0 ? "none"  // idle view persisted
        : s.tabs[Math.min(s.selected_tab, s.tabs.length - 1)] || "spectrum";
    renderTabs(); loadPanel(); applyScheme(s.colour_scheme);
  }
  const el = $("#status");
  if (el) {
    const d = s.diagnostics || {};
    el.textContent = s.engine + "  " + (d.fps ? d.fps.toFixed(0) + " fps " : "") +
        (s.freeze ? "  FROZEN" : "");
  }
  // rebuild/feed-tier edits mark the widget panel stale: refetch so
  // dependent widget values and display texts track the server
  if (state.layoutStale) { state.layoutStale = false; loadPanel(); }
}
async function frameLoop() {
  try {
    if (state.tab === "none") {
      drawDefaultView();
    } else if (state.tab === "graph") {
      state.graph = state.graph || await api.get("/api/graph");
      drawGraph();
    } else if (state.tab !== "global") {
      const f = await api.get("/api/frame/" + state.tab);
      if (f.ready) {
        state.lastFrame = f;
        if (state.tab === "spectrum") drawSpectrum(f);
        else if (state.tab === "oscilloscope") drawOscilloscope(f);
        else if (state.tab === "vectorscope") drawVectorscope(f);
        else if (state.tab === "spectrogram") drawSpectrogram(f);
      }
    }
  } catch (e) { /* server restarting */ }
  setTimeout(frameLoop, state.pollMs);
}
setInterval(refreshState, 1000);
setInterval(() => { if (state.tab === "graph") api.get("/api/graph").then(g => state.graph = g); }, 2000);
fit();
refreshState().then(frameLoop);
</script>
</body>
</html>
"""
