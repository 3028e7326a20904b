/* Console core: tab registry, fetch helpers, tiny DOM utilities.
   Each views_*.js module registers tabs via UI.tab(name, html, onShow).
   Dependency-free — this is the operator console for the JSON API
   (the functional core of the reference's React frontend/src). */
"use strict";

const UI = (() => {
  const tabs = [];   // {name, html, onShow}
  const J = (r) => r.json();
  const esc = (s) => String(s ?? "").replace(/[&<>"]/g,
    (c) => ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;" }[c]));
  // Safe argument embedding for inline handlers: esc() covers HTML
  // context but NOT a single-quoted JS string inside an inline handler
  // attribute — a value containing ' would break out (stored script
  // injection in the operator console). arg() percent-encodes
  // (including ', which encodeURIComponent leaves alone); d() decodes
  // at call time: handler(UI.d('${UI.arg(value)}')).
  const arg = (s) => encodeURIComponent(String(s ?? ""))
    .replace(/'/g, "%27");
  const d = decodeURIComponent;

  async function get(url) {
    const r = await fetch(url);
    return r.json();
  }
  async function post(url, body, method = "POST") {
    const r = await fetch(url, {
      method, headers: { "Content-Type": "application/json" },
      body: body === undefined ? "{}" : JSON.stringify(body),
    });
    return r.json();
  }
  function table(headers, rows) {
    return "<table><tr>" + headers.map((h) => `<th>${h}</th>`).join("") +
      "</tr>" + rows.join("") + "</table>";
  }
  function pre(obj) {
    return `<pre>${esc(typeof obj === "string" ? obj : JSON.stringify(obj, null, 2))}</pre>`;
  }
  function lbl(level) {
    return `<span class="lbl-${esc(level)}">${esc(level)}</span>`;
  }
  function hits(list) {
    return (list || []).map((h) => `<div class="hit"><b>${esc(h.chunk_id)}</b>
      <span class="meta"> ${esc(h.doc_id)} · score ${(h.score ?? 0).toFixed(3)}</span>
      ${h.signals && Object.keys(h.signals).length ? signalBar(h.signals) : ""}
      <div>${esc((h.text || "").slice(0, 400))}</div></div>`).join("")
      || "<p class=meta>no hits</p>";
  }
  function signalBar(sig) {
    const keys = ["sim", "cosine", "authority", "length", "jpd", "coverage", "rrf", "cross_encoder"];
    const parts = keys.filter((k) => sig[k] !== undefined)
      .map((k) => `${k} <b>${Number(sig[k]).toFixed(3)}</b>`);
    return `<div class=meta>${parts.join(" · ")}</div>`;
  }

  function tab(name, html, onShow) { tabs.push({ name, html, onShow }); }

  function boot() {
    const nav = document.getElementById("nav");
    const main = document.getElementById("main");
    tabs.forEach((t) => {
      const b = document.createElement("button");
      b.textContent = t.name;
      b.onclick = () => show(t.name);
      nav.appendChild(b);
      const d = document.createElement("div");
      d.className = "tab"; d.id = "tab-" + t.name; d.innerHTML = t.html;
      main.appendChild(d);
    });
    show(tabs[0].name);
    stats();
    setInterval(stats, 10000);
  }
  function show(name) {
    const nav = document.getElementById("nav");
    const main = document.getElementById("main");
    [...nav.querySelectorAll("button")].forEach((b, i) =>
      b.classList.toggle("on", tabs[i].name === name));
    [...main.querySelectorAll(".tab")].forEach((d) =>
      d.classList.toggle("on", d.id === "tab-" + name));
    const t = tabs.find((x) => x.name === name);
    if (t && t.onShow) t.onShow();
  }
  async function stats() {
    try {
      const h = await get("/health");
      const v = await get("/version");
      document.getElementById("stats").textContent =
        `${h.chunks} chunks · capacity ${h.capacity} · backend ${v.vector_backend} · v${v.version}`;
    } catch (e) { /* server warming */ }
  }

  return { tab, boot, show, get, post, table, pre, lbl, hits, esc, arg, d, J };
})();
